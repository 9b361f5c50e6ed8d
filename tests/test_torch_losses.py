"""Port's loss stack against the JAX package's: every term of ``terms.py`` on
its own, ``compute_losses`` at one scale, and the weighted 5-scale
``unsupervised_loss`` with its logs and its gradient to the flows. The port is
NCHW, the JAX package NHWC; float32, relative tolerance 1e-5 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.losses import terms as terms_jax
from unflow_tpu.losses.unsupervised import compute_losses as compute_losses_jax
from unflow_tpu.losses.unsupervised import unsupervised_loss as unsupervised_loss_jax
from unflow_tpu_torch.losses import (
    DEFAULT_WEIGHTS,
    LAYER_PATCH_DISTANCES,
    LAYER_WEIGHTS,
    LOSS_KEYS,
    compute_losses,
    terms,
    unsupervised_loss,
)

torch.set_num_threads(1)

RTOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got.detach()) if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=rtol * max(float(np.abs(np.asarray(want)).max()), 1e-6),
    )


def test_constants_match_jax():
    from unflow_tpu.losses import unsupervised as u

    assert LOSS_KEYS == u.LOSS_KEYS
    assert LAYER_WEIGHTS == u.LAYER_WEIGHTS
    assert LAYER_PATCH_DISTANCES == u.LAYER_PATCH_DISTANCES
    assert DEFAULT_WEIGHTS == u.DEFAULT_WEIGHTS


def test_length_sq():
    x = _rand((2, 4, 5, 2), 0)
    _close(_nhwc(terms.length_sq(_nchw(x))), terms_jax.length_sq(jnp.asarray(x)))


@pytest.mark.parametrize("kwargs", [{}, {"beta": 255.0}, {"truncate": 0.5}, {"alpha": 0.3}])
@pytest.mark.parametrize("masked", [False, True])
def test_charbonnier_loss(kwargs, masked):
    x = _rand((2, 4, 5, 3), 1)
    mask = (np.random.RandomState(2).rand(2, 4, 5, 1) > 0.4).astype(np.float32)
    want = terms_jax.charbonnier_loss(jnp.asarray(x), jnp.asarray(mask) if masked else None, **kwargs)
    got = terms.charbonnier_loss(_nchw(x), _nchw(mask) if masked else None, **kwargs)
    _close(got, want)


def test_charbonnier_loss_of_an_empty_slice_is_zero():
    assert terms.charbonnier_loss(torch.zeros(2, 2, 1, 0)).item() == 0.0


def test_create_outgoing_mask():
    flow = _rand((2, 6, 8, 2), 3, scale=4.0)
    want = terms_jax.create_outgoing_mask(jnp.asarray(flow))
    got = terms.create_outgoing_mask(_nchw(flow))
    assert got.shape == (2, 1, 6, 8)
    assert np.array_equal(_nhwc(got), np.asarray(want))
    assert 0 < got.sum() < got.numel()


@pytest.mark.parametrize("hw,distance", [((8, 10), 2), ((5, 18), 3), ((1, 2), 1), ((3, 3), 5)])
def test_create_border_mask(hw, distance):
    want = terms_jax.create_border_mask((2, *hw, 3), distance)
    got = terms.create_border_mask((2, 3, *hw), distance)
    assert np.array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("hw,distance", [((8, 10), 1), ((8, 10), 3), ((1, 2), 1)])
def test_ternary_transform_and_hamming(hw, distance):
    im1 = np.random.RandomState(4).rand(2, *hw, 3).astype(np.float32)
    im2 = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    want1 = terms_jax.ternary_transform(jnp.asarray(im1), distance)
    want2 = terms_jax.ternary_transform(jnp.asarray(im2), distance)
    got1 = terms.ternary_transform(_nchw(im1), distance)
    got2 = terms.ternary_transform(_nchw(im2), distance)
    assert got1.shape == (2, (2 * distance + 1) ** 2, *hw)
    _close(_nhwc(got1), want1)  # same patch order and zero padding
    _close(_nhwc(terms.hamming_distance_soft(got1, got2)),
           terms_jax.hamming_distance_soft(want1, want2))


def test_ternary_transform_of_one_channel_takes_the_mean_path():
    im = np.random.RandomState(6).rand(1, 5, 6, 1).astype(np.float32)
    _close(_nhwc(terms.ternary_transform(_nchw(im), 1)),
           terms_jax.ternary_transform(jnp.asarray(im), 1))


@pytest.mark.parametrize("name", ["ternary_loss", "gradient_loss"])
def test_data_terms(name):
    im1 = np.random.RandomState(7).rand(2, 8, 10, 3).astype(np.float32)
    im2 = np.random.RandomState(8).rand(2, 8, 10, 3).astype(np.float32)
    mask = (np.random.RandomState(9).rand(2, 8, 10, 1) > 0.3).astype(np.float32)
    want = getattr(terms_jax, name)(jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(mask))
    got = getattr(terms, name)(_nchw(im1), _nchw(im2), _nchw(mask))
    _close(got, want)


def test_photometric_loss():
    diff = _rand((2, 8, 10, 3), 10, scale=0.1)
    mask = (np.random.RandomState(11).rand(2, 8, 10, 1) > 0.3).astype(np.float32)
    _close(terms.photometric_loss(_nchw(diff), _nchw(mask)),
           terms_jax.photometric_loss(jnp.asarray(diff), jnp.asarray(mask)))


@pytest.mark.parametrize("name", ["smoothness_loss", "second_order_loss"])
@pytest.mark.parametrize("hw", [(8, 10), (1, 2), (2, 5)])
def test_smoothness_terms(name, hw):
    flow = _rand((2, *hw, 2), 12)
    want = getattr(terms_jax, name)(jnp.asarray(flow))
    got = getattr(terms, name)(_nchw(flow))
    assert np.isfinite(got.item())
    _close(got, want)


def _scene(hw, seed, flow_scale=1.5):
    rng = np.random.RandomState(seed)
    im1 = rng.rand(2, *hw, 3).astype(np.float32)
    im2 = rng.rand(2, *hw, 3).astype(np.float32)
    return im1, im2, rng


ALL_ON = {key: 1.0 + 0.1 * i for i, key in enumerate(LOSS_KEYS)}


@pytest.mark.parametrize("mask_occlusion", ["fb", ""])
@pytest.mark.parametrize("with_border", [False, True])
def test_compute_losses_every_term(mask_occlusion, with_border):
    im1, im2, rng = _scene((10, 12), 13)
    # flows large enough that some pixels leave the frame and some are occluded
    fw = (rng.randn(2, 10, 12, 2) * 2.0).astype(np.float32)
    bw = (-fw + rng.randn(2, 10, 12, 2) * 0.7).astype(np.float32)
    border_j = terms_jax.create_border_mask((2, 10, 12, 3), 2) if with_border else None
    border_t = terms.create_border_mask((2, 3, 10, 12), 2) if with_border else None
    want = compute_losses_jax(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(fw), jnp.asarray(bw),
        border_mask=border_j, mask_occlusion=mask_occlusion, data_max_distance=2,
    )
    got = compute_losses(
        _nchw(im1), _nchw(im2), _nchw(fw), _nchw(bw),
        border_mask=border_t, mask_occlusion=mask_occlusion, data_max_distance=2,
    )
    assert set(got) == set(want) == set(LOSS_KEYS)
    for key in LOSS_KEYS:
        _close(got[key], want[key])
    assert float(want["occ"]) > 2 * 0.001**0.9  # some pixel is occluded


def test_compute_losses_skips_terms_of_weight_zero():
    im1, im2, rng = _scene((6, 8), 14)
    fw = _nchw(rng.randn(2, 6, 8, 2).astype(np.float32))
    got = compute_losses(_nchw(im1), _nchw(im2), fw, -fw, weights=DEFAULT_WEIGHTS)
    assert set(got) == {"occ", "fb", "ternary", "smooth_2nd"}


def test_compute_losses_rejects_unported_and_unknown_masking():
    im = torch.rand(1, 3, 4, 4)
    flow = torch.zeros(1, 2, 4, 4)
    with pytest.raises(NotImplementedError, match="A9"):
        compute_losses(im, im, flow, flow, mask_occlusion="disocc")
    with pytest.raises(ValueError, match="unknown mask_occlusion"):
        compute_losses(im, im, flow, flow, mask_occlusion="both")


def _pyramid(hw, seed):
    """Five flow levels for a crop ``hw``, finest (1/4) first, in network units."""
    rng = np.random.RandomState(seed)
    h, w = hw
    return [
        (rng.randn(2, h // (4 * 2**i), w // (4 * 2**i), 2) * 0.4 * 2**i / 5.0).astype(np.float32)
        for i in range(5)
    ]


@pytest.mark.parametrize(
    "weights,border_ratio", [(None, 0.0), (ALL_ON, 0.1), ({"photo": 0.5, "ternary": 0.0}, 0.0)]
)
def test_unsupervised_loss_matches_jax(weights, border_ratio):
    hw = (64, 128)  # the coarsest level is 1x2
    im1, im2, _ = _scene(hw, 15)
    fw, bw = _pyramid(hw, 16), _pyramid(hw, 17)
    want_total, want_logs = unsupervised_loss_jax(
        jnp.asarray(im1), jnp.asarray(im2), [jnp.asarray(f) for f in fw],
        [jnp.asarray(f) for f in bw], weights=weights, border_ratio=border_ratio,
    )
    got_total, got_logs = unsupervised_loss(
        _nchw(im1), _nchw(im2), [_nchw(f) for f in fw], [_nchw(f) for f in bw],
        weights=weights, border_ratio=border_ratio,
    )
    assert set(got_logs) == set(want_logs)
    assert "total" in got_logs and "occ/scale4" in got_logs
    for key, value in want_logs.items():
        _close(got_logs[key], value)
    _close(got_total, want_total)
    assert got_total.dtype == torch.float32


def test_unsupervised_loss_gradient_to_the_flows_matches_jax():
    # tolerance 1e-4 of the largest entry per level: sums over up to 49 census
    # channels and the scatter of the warp's gradient run in another order
    hw = (64, 128)
    im1, im2, _ = _scene(hw, 18)
    fw, bw = _pyramid(hw, 19), _pyramid(hw, 20)

    def loss_jax(fw_, bw_):
        return unsupervised_loss_jax(jnp.asarray(im1), jnp.asarray(im2), fw_, bw_)[0]

    want_fw, want_bw = jax.grad(loss_jax, argnums=(0, 1))(
        [jnp.asarray(f) for f in fw], [jnp.asarray(f) for f in bw]
    )
    t_fw = [_nchw(f).requires_grad_() for f in fw]
    t_bw = [_nchw(f).requires_grad_() for f in bw]
    unsupervised_loss(_nchw(im1), _nchw(im2), t_fw, t_bw)[0].backward()
    for level, (got, want) in enumerate(zip(t_fw + t_bw, list(want_fw) + list(want_bw))):
        if level % 5 < 4:  # the 1x2 level's samples all leave the frame: masked, gradient 0
            assert np.abs(np.asarray(want)).max() > 0
        _close(_nhwc(got.grad), want, rtol=1e-4)
